// Flash attention for Hopper tensor cores (sm_90a): the forward (B7), both
// backward passes (B8), the ring hop's carried-state fold (B9) and B9's
// backward on bf16 wgmma tiles fed by TMA, built on sm90_tiles.cuh. Plain C
// interface, bound with ctypes by ops/attention_kernels.py, which picks this
// form for bf16 inputs with head_dim 64 or 128 (`kernel_form`).
//
// Replaces (mlsl_tpu/ops/attention_kernels.py), as a second design of the kernels
// that attention_kernels.cu ports on the CUDA cores:
//   mlsl_flash_fwd_sm90      B7 `_flash_fwd` (:154, body `_tile_accumulate` :88)
//   mlsl_flash_bwd_dq_sm90   B8 `_flash_bwd` (:297), dq pallas_call (:311, `_bwd_dq_kernel` :236)
//   mlsl_flash_bwd_dkv_sm90  B8 `_flash_bwd` (:297), dk/dv pallas_call (:335, `_bwd_dkv_kernel` :264)
//   mlsl_block_update_sm90   B9 `_block_update_fwd` (:442, body `_block_kernel` :416):
//                            `bu_sm90`, the forward's body with the carried state
//   mlsl_block_update_bwd_dq_sm90, mlsl_block_update_bwd_dkv_sm90
//                            B9's vjp, which the TPU leaves to XLA (`_bu_bwd` :530,
//                            jax.vjp of `_block_update_ref`): `bu_dq_sm90`,
//                            `bu_dkv_sm90`, B8's passes with B9's inputs
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
// use P in float32. B9's backward takes its cotangent ga as dO, rounded to bf16
// once by the caller. The plain versions reproduce this with p_dtype (and for
// ga g_dtype) bfloat16.
//
// B9 (fwd_body with the carried state): acc, m and l come in as float32 (BH,
// Sq[, D]): acc straight into the accumulator fragment, l on one of the four
// lanes of a row, m as the running maximum, which B9 keeps in natural units
// (of s = (q.k) scale; B7 keeps s scale log2 e) so that m' = max(m, max_j
// fl(s_j)) exactly and a row that no key beats keeps its m bit for bit; the
// exponent takes m' log2 e. They leave unnormalised into new tensors, also
// where the offsets hide every tile (then exactly as they came in). On
// request the fold also returns, per row, the index of its first maximal key
// where that key beat the carried m, and -1 where m won: the backward gives
// the term through the max to that entry alone (torch and JAX split ties).
// B9's backward (BU): lse := m' makes P = exp(s - m'), dd := -gl and dO := ga
// make dS = P (ga V^T + gl), B8's dS with other inputs; each pass then adds g
// = gm - Delta (computed by the caller) to dS at the row's winner in registers
// before dS is rounded, with no atomics. The dk/dv pass brings the winners and
// g of a query tile in the same bulk copies as its lse and dd.
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
// per visible (q, k) pair in B7, 6 D in the dq pass, 8 D in dk/dv, the same in
// B9's backward. B9's forward is bound by bytes (3.35 TB/s): at the ring's
// shapes its float32 acc, read and written, outweighs q, k and v, so the fold
// reads acc while Q's tiles arrive and writes it once, straight from the
// registers; the winner, a compare and select per entry, is tracked only in
// the instantiation a gradient asks for. At D = 64
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

// B9's term through the row maximum: dS += g at the entry of the row's winning
// key (win: its index in the block, -1 where the carried maximum won; never a
// hidden key). Rows of the fragment are queries (the dq pass: win and g per
// row h, `first` the index of the tile's first key) or keys (KEY_ROWS, the
// dk/dv pass: win and g per query column from shared memory, `first` the index
// of the key in row h = 0).
template <bool KEY_ROWS>
__device__ __forceinline__ void max_term(float (&ds)[32], const int* win, const float* g,
                                         int first, int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c0 + e;
        if (KEY_ROWS ? win[col] == first + 8 * h : win[h] == first + col)
          ds[4 * j + 2 * h + e] += KEY_ROWS ? g[col] : g[h];
      }
}

// B9's online softmax: softmax_step for a carried state. The running row
// maxima mn stay in natural units (of s * scale), so that m' = max(m, max_j
// fl(s_j scale)) exactly and a row that no key beats keeps its m bit for bit;
// m2 = mn log2 e feeds the exponent. Hidden entries keep their raw NEG, and a
// tile that hides a whole row leaves its state as it was (corr = 1, P = 0).
// WIN: win[h] becomes the index in the block (key0 + column) of the row's
// maximal score where it beats the maximum so far, the first of equal maxima.
template <bool MASK, bool WIN>
__device__ __forceinline__ void carry_step(float (&s)[32], float (&mn)[2], float (&lp)[2],
                                           float (&corr)[2], int (&win)[2], float scale,
                                           float c, int k_first, int q_row, int c0, int key0) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        if (MASK && hidden<MASK>(k_first, q_row, j, h, e, c0)) x = NEG;
        mx[h] = fmaxf(mx[h], x);
      }
  float m2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mr = quad_max(mx[h]);                 // the tile's raw row maximum
    // max(s) scale = max(s scale): scale > 0 and rounding is monotone
    const float mt = MASK && mr <= 0.5f * NEG ? NEG : mr * scale;
    const float m_new = fmaxf(mn[h], mt);
    corr[h] = ex2((mn[h] - m_new) * LOG2E);
    if (WIN) {
      int first = 64;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (s[4 * j + 2 * h + e] == mr) first = min(first, 8 * j + c0 + e);
      first = min(first, __shfl_xor_sync(0xffffffffu, first, 1));
      first = min(first, __shfl_xor_sync(0xffffffffu, first, 2));
      if (mt > mn[h]) win[h] = key0 + first;
    }
    mn[h] = m_new;
    m2[h] = m_new * LOG2E;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = MASK && x <= 0.5f * NEG ? 0.f : ex2(fmaf(x, c, -m2[h]));
        ps[h] += x;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) lp[h] = lp[h] * corr[h] + ps[h];
}

// -- B7 and B9 ----------------------------------------------------------------------

// B9's carried state: acc (BH, Sq, D), m and l (BH, Sq), float32, read and
// written unnormalised into new tensors; win (BH, Sq) int32 where the variant
// tracks the winner.
struct Carry {
  const float* acc_in;
  const float* m_in;
  const float* l_in;
  float* acc_out;
  float* m_out;
  float* l_out;
  int* win;
};

// What fwd_body computes: B7 (a fresh state, output normalised, lse), or B9
// (the carried state in and out), with or without the winner.
constexpr int FWD = 0, CARRY = 1, CARRY_WIN = 2;

template <int D, int NWG, int MODE>
__device__ __forceinline__ void fwd_body(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const int* __restrict__ q_off,
                                         const int* __restrict__ k_off, int sq, int sk,
                                         float scale, int causal, __nv_bfloat16* __restrict__ o,
                                         float* __restrict__ lse, const Carry& carry) {
  constexpr int NB = D / 64, BM = 64 * NWG;
  constexpr bool CARRIED = MODE != FWD, WIN = MODE == CARRY_WIN;
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
  const long row0 = (long)bh * sq + q0 + 64 * wg + r0;
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
  float mn[2] = {NEG, NEG};                           // B9: the running maxima, natural units
  int win[2] = {-1, -1};
  if constexpr (CARRIED) {
    // the carried state, read while the tiles arrive; l on one lane of the 4
    // that share a row, so that their sum at the end counts it once
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = row0 + 8 * h;
      mn[h] = carry.m_in[row];
      lp[h] = (t & 3) == 0 ? carry.l_in[row] : 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 a =
              *reinterpret_cast<const float2*>(carry.acc_in + row * D + 64 * nb + 8 * j + c0);
          acc[nb][4 * j + 2 * h] = a.x;
          acc[nb][4 * j + 2 * h + 1] = a.y;
        }
    }
  } else {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  }
  float s[32];
  uint32_t pa[4][4];
  auto slot = [&](int i) { return sKV + (i % STAGES) * SLOT; };
  auto softmax = [&](int i) {
    const int k_first = ko + 64 * i;
    const bool cross = causal && k_first + 63 > wg_q;
    if constexpr (CARRIED) {
      if (cross)
        carry_step<true, WIN>(s, mn, lp, corr, win, scale, c, k_first, q_row, c0, 64 * i);
      else
        carry_step<false, WIN>(s, mn, lp, corr, win, scale, c, k_first, q_row, c0, 64 * i);
    } else {
      if (cross)
        softmax_step<true>(s, m2, lp, corr, c, k_first, q_row, c0);
      else
        softmax_step<false>(s, m2, lp, corr, c, k_first, q_row, c0);
    }
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
    const long row = row0 + 8 * h;
    if constexpr (CARRIED) {
      // a row that saw no key: acc, m and l as they came in, bit for bit
      const float l_new = quad_sum(lp[h]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(carry.acc_out + row * D + 64 * nb + 8 * j + c0) =
              make_float2(acc[nb][4 * j + 2 * h], acc[nb][4 * j + 2 * h + 1]);
      if ((t & 3) == 0) {
        carry.m_out[row] = mn[h];
        carry.l_out[row] = l_new;
        if (WIN) carry.win[row] = win[h];
      }
    } else {
      const float denom = fmaxf(quad_sum(lp[h]), 1e-30f);
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
}

// B7: a fresh state, the normalised output and the lse.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + PRODUCER, 1)
fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_off,
         const int* __restrict__ k_off, int sq, int sk, float scale, int causal,
         __nv_bfloat16* __restrict__ o, float* __restrict__ lse) {
  fwd_body<D, NWG, FWD>(tq, tk, tv, q_off, k_off, sq, sk, scale, causal, o, lse, Carry{});
}

// B9: the carried state in and out; WIN: also each row's winner.
template <int D, int NWG, bool WIN>
__global__ void __launch_bounds__(NWG * 128 + PRODUCER, 1)
bu_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_off,
        const int* __restrict__ k_off, int sq, int sk, float scale, int causal,
        const Carry carry) {
  fwd_body<D, NWG, WIN ? CARRY_WIN : CARRY>(tq, tk, tv, q_off, k_off, sq, sk, scale, causal,
                                            nullptr, nullptr, carry);
}

// -- B8, dq pass -------------------------------------------------------------------

// BU: B9's backward (lse := m', dd := -gl, dO := ga), plus g = gm - Delta at
// each row's winner (win, g (BH, Sq)); else B8's, with win and g null.
template <int D, int NWG, bool BU>
__device__ __forceinline__ void dq_body(const CUtensorMap& tq, const CUtensorMap& tk,
                                        const CUtensorMap& tv, const CUtensorMap& tdo,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ dd,
                                        const int* __restrict__ win,
                                        const float* __restrict__ gmax,
                                        const int* __restrict__ q_off,
                                        const int* __restrict__ k_off, int sq, int sk,
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
  float lse_r[2], dd_r[2], g_r[2];
  int win_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = lse[row0 + 8 * h];
    dd_r[h] = dd[row0 + 8 * h];
    if (BU) {
      win_r[h] = win[row0 + 8 * h];
      g_r[h] = gmax[row0 + 8 * h];
    }
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
    if (BU) max_term<false>(dp, win_r, g_r, 64 * i, c0);
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

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + PRODUCER, 1)
dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
        const float* __restrict__ lse, const float* __restrict__ dd,
        const int* __restrict__ q_off, const int* __restrict__ k_off, int sq, int sk,
        float scale, int causal, __nv_bfloat16* __restrict__ dq) {
  dq_body<D, NWG, false>(tq, tk, tv, tdo, lse, dd, nullptr, nullptr, q_off, k_off, sq, sk,
                         scale, causal, dq);
}

// B9's backward, dq pass.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + PRODUCER, 1)
bu_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tga,
           const float* __restrict__ m_new, const float* __restrict__ neg_gl,
           const int* __restrict__ win, const float* __restrict__ gmax,
           const int* __restrict__ q_off, const int* __restrict__ k_off, int sq, int sk,
           float scale, int causal, __nv_bfloat16* __restrict__ dq) {
  dq_body<D, NWG, true>(tq, tk, tv, tga, m_new, neg_gl, win, gmax, q_off, k_off, sq, sk, scale,
                        causal, dq);
}

// -- B8, dk/dv pass ----------------------------------------------------------------

// BU as in dq_body.
template <int D, int NWG, bool BU>
__device__ __forceinline__ void dkv_body(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const CUtensorMap& tdo,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ dd,
                                         const int* __restrict__ win,
                                         const float* __restrict__ gmax,
                                         const int* __restrict__ q_off,
                                         const int* __restrict__ k_off, int sq, int sk,
                                         float scale, int causal, __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv) {
  constexpr int NB = D / 64, BN = 64 * NWG;
  // a slot: Q and dO tiles, then the 64 lse and 64 dd values of their rows
  // (BU: and their 64 winners and g)
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
        mbar_expect_tx(full, TILES + (BU ? 1024 : 512));
        for (int b = 0; b < NB; ++b) {
          tma_load(slot + b * TILE_BYTES, &tq, full, (int)qrow, 64 * b);
          tma_load(slot + (NB + b) * TILE_BYTES, &tdo, full, (int)qrow, 64 * b);
        }
        bulk_load(slot + TILES, lse + qrow, 256, full);
        bulk_load(slot + TILES + 256, dd + qrow, 256, full);
        if (BU) {
          bulk_load(slot + TILES + 512, win + qrow, 256, full);
          bulk_load(slot + TILES + 768, gmax + qrow, 256, full);
        }
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
    if (BU)
      max_term<true>(dpt, reinterpret_cast<const int*>(sL + 128), sL + 192,
                     k0 + 64 * wg + r0, c0);
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

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + PRODUCER, 1)
dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
         const float* __restrict__ lse, const float* __restrict__ dd,
         const int* __restrict__ q_off, const int* __restrict__ k_off, int sq, int sk,
         float scale, int causal, __nv_bfloat16* __restrict__ dk,
         __nv_bfloat16* __restrict__ dv) {
  dkv_body<D, NWG, false>(tq, tk, tv, tdo, lse, dd, nullptr, nullptr, q_off, k_off, sq, sk,
                          scale, causal, dk, dv);
}

// B9's backward, dk/dv pass.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + PRODUCER, 1)
bu_dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tga,
            const float* __restrict__ m_new, const float* __restrict__ neg_gl,
            const int* __restrict__ win, const float* __restrict__ gmax,
            const int* __restrict__ q_off, const int* __restrict__ k_off, int sq, int sk,
            float scale, int causal, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv) {
  dkv_body<D, NWG, true>(tq, tk, tv, tga, m_new, neg_gl, win, gmax, q_off, k_off, sq, sk, scale,
                         causal, dk, dv);
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

// Each pass: D = 64 with two consumer warpgroups; D = 128 with two for B7, B9
// and dq and one for dk/dv, whose two D-wide float32 accumulators leave no
// room for a second warpgroup's registers.
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

template <int D, bool WIN>
int bu_t(const Maps& m, const int* qo, const int* ko, const Carry& carry, int bh, int sq,
         int sk, float scale, int causal, cudaStream_t st) {
  constexpr int NWG = 2;
  auto kern = bu_sm90<D, NWG, WIN>;
  const size_t smem = fwd_smem<D, NWG>();
  int rc = prep(kern, smem);
  if (rc) return rc;
  kern<<<dim3(bh, sq / (64 * NWG)), NWG * 128 + PRODUCER, smem, st>>>(
      m.q, m.k, m.v, qo, ko, sq, sk, scale, causal, carry);
  return (int)cudaGetLastError();
}

// B8's passes (BU false; win and gmax null) or B9's (BU).
template <int D, bool BU>
int dq_t(const Maps& m, const float* lse, const float* dd, const int* win, const float* gmax,
         const int* qo, const int* ko, void* dq, int bh, int sq, int sk, float scale,
         int causal, cudaStream_t st) {
  constexpr int NWG = 2;
  const size_t smem = dq_smem<D, NWG>();
  const dim3 grid(bh, sq / (64 * NWG));
  int rc;
  if constexpr (BU) {
    rc = prep(bu_dq_sm90<D, NWG>, smem);
    if (rc) return rc;
    bu_dq_sm90<D, NWG><<<grid, NWG * 128 + PRODUCER, smem, st>>>(
        m.q, m.k, m.v, m.o, lse, dd, win, gmax, qo, ko, sq, sk, scale, causal,
        (__nv_bfloat16*)dq);
  } else {
    rc = prep(dq_sm90<D, NWG>, smem);
    if (rc) return rc;
    dq_sm90<D, NWG><<<grid, NWG * 128 + PRODUCER, smem, st>>>(
        m.q, m.k, m.v, m.o, lse, dd, qo, ko, sq, sk, scale, causal, (__nv_bfloat16*)dq);
  }
  return (int)cudaGetLastError();
}

template <int D, bool BU>
int dkv_t(const Maps& m, const float* lse, const float* dd, const int* win, const float* gmax,
          const int* qo, const int* ko, void* dk, void* dv, int bh, int sq, int sk, float scale,
          int causal, cudaStream_t st) {
  constexpr int NWG = D == 64 ? 2 : 1;
  const size_t smem = dkv_smem<D, NWG>();
  const dim3 grid(bh, sk / (64 * NWG));
  int rc;
  if constexpr (BU) {
    rc = prep(bu_dkv_sm90<D, NWG>, smem);
    if (rc) return rc;
    bu_dkv_sm90<D, NWG><<<grid, NWG * 128 + PRODUCER, smem, st>>>(
        m.q, m.k, m.v, m.o, lse, dd, win, gmax, qo, ko, sq, sk, scale, causal,
        (__nv_bfloat16*)dk, (__nv_bfloat16*)dv);
  } else {
    rc = prep(dkv_sm90<D, NWG>, smem);
    if (rc) return rc;
    dkv_sm90<D, NWG><<<grid, NWG * 128 + PRODUCER, smem, st>>>(
        m.q, m.k, m.v, m.o, lse, dd, qo, ko, sq, sk, scale, causal, (__nv_bfloat16*)dk,
        (__nv_bfloat16*)dv);
  }
  return (int)cudaGetLastError();
}

bool shapes_ok(int bh, int sq, int sk, int d, int dtype) {
  return bh > 0 && sq > 0 && sk > 0 && sq % 128 == 0 && sk % 128 == 0 && (d == 64 || d == 128) &&
         dtype == 1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool BU>
int dq_entry(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* dd, const int* win, const float* gmax, const int* q_off,
             const int* k_off, void* dq, int bh, int sq, int sk, int d, float scale, int causal,
             int dtype, void* stream) {
  if (!shapes_ok(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  Maps m;
  int rc = make_maps(&m, q, k, v, dout, bh, sq, sk, d);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  return d == 64 ? dq_t<64, BU>(m, lse, dd, win, gmax, q_off, k_off, dq, bh, sq, sk, scale,
                                causal, st)
                 : dq_t<128, BU>(m, lse, dd, win, gmax, q_off, k_off, dq, bh, sq, sk, scale,
                                 causal, st);
}

template <bool BU>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* dd, const int* win, const float* gmax, const int* q_off,
              const int* k_off, void* dk, void* dv, int bh, int sq, int sk, int d, float scale,
              int causal, int dtype, void* stream) {
  if (!shapes_ok(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  if (!aligned16(lse) || !aligned16(dd) || (BU && (!aligned16(win) || !aligned16(gmax))))
    return (int)cudaErrorMisalignedAddress;
  Maps m;
  int rc = make_maps(&m, q, k, v, dout, bh, sq, sk, d);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  return d == 64 ? dkv_t<64, BU>(m, lse, dd, win, gmax, q_off, k_off, dk, dv, bh, sq, sk, scale,
                                 causal, st)
                 : dkv_t<128, BU>(m, lse, dd, win, gmax, q_off, k_off, dk, dv, bh, sq, sk,
                                  scale, causal, st);
}

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
  return dq_entry<false>(q, k, v, dout, lse, dd, nullptr, nullptr, q_off, k_off, dq, bh, sq, sk,
                         d, scale, causal, dtype, stream);
}

// B8, dk/dv pass. lse and dd must be 16-byte aligned: their rows travel by bulk copy.
int mlsl_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dd, const int* q_off,
                            const int* k_off, void* dk, void* dv, int bh, int sq, int sk,
                            int d, float scale, int causal, int dtype, void* stream) {
  return dkv_entry<false>(q, k, v, dout, lse, dd, nullptr, nullptr, q_off, k_off, dk, dv, bh, sq,
                          sk, d, scale, causal, dtype, stream);
}

// B9. acc (BH, Sq, D), m, l (BH, Sq) float32 in; acc_out, m_out, l_out new
// float32 tensors of the same shapes; win (BH, Sq) int32, or null where no
// winner is wanted.
int mlsl_block_update_sm90(const void* q, const void* k, const void* v, const int* q_off,
                           const int* k_off, const float* acc, const float* m_in,
                           const float* l_in, float* acc_out, float* m_out, float* l_out,
                           int* win, int bh, int sq, int sk, int d, float scale, int causal,
                           int dtype, void* stream) {
  if (!shapes_ok(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  Maps m;
  int rc = make_maps(&m, q, k, v, nullptr, bh, sq, sk, d);
  if (rc) return rc;
  const Carry carry{acc, m_in, l_in, acc_out, m_out, l_out, win};
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64)
    return win ? bu_t<64, true>(m, q_off, k_off, carry, bh, sq, sk, scale, causal, st)
               : bu_t<64, false>(m, q_off, k_off, carry, bh, sq, sk, scale, causal, st);
  return win ? bu_t<128, true>(m, q_off, k_off, carry, bh, sq, sk, scale, causal, st)
             : bu_t<128, false>(m, q_off, k_off, carry, bh, sq, sk, scale, causal, st);
}

// B9's backward, dq pass: ga (BH, Sq, D) in q's type (bf16), m_new the
// forward's m', neg_gl = -gl, win the forward's winner and gmax = gm - Delta
// (BH, Sq).
int mlsl_block_update_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* ga,
                                  const float* m_new, const float* neg_gl, const int* win,
                                  const float* gmax, const int* q_off, const int* k_off,
                                  void* dq, int bh, int sq, int sk, int d, float scale,
                                  int causal, int dtype, void* stream) {
  return dq_entry<true>(q, k, v, ga, m_new, neg_gl, win, gmax, q_off, k_off, dq, bh, sq, sk, d,
                        scale, causal, dtype, stream);
}

// B9's backward, dk/dv pass; the four row vectors 16-byte aligned (bulk copies).
int mlsl_block_update_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* ga,
                                   const float* m_new, const float* neg_gl, const int* win,
                                   const float* gmax, const int* q_off, const int* k_off,
                                   void* dk, void* dv, int bh, int sq, int sk, int d,
                                   float scale, int causal, int dtype, void* stream) {
  return dkv_entry<true>(q, k, v, ga, m_new, neg_gl, win, gmax, q_off, k_off, dk, dv, bh, sq,
                         sk, d, scale, causal, dtype, stream);
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
